"""The static verifier (``fluid/analysis``) of the port against the JAX
package's, and its hooks in the port, on the CPU.

Parity: the same program built by both packages gives the same findings
(check, severity, block, op index, var) from each package's
``verify_program``, and ``analyze_live_ranges`` the same bytes, ranges
and categories to the byte.  Programs: tiny BERT pretraining (fused
stack, f32 and bf16 AMP), tiny ResNet after the conv+BN fusion (f32 and
AMP), the frozen tiny BERT, the tiny hapi NMT (f32 and AMP), and one
broken program per check of the JAX package's ``tests/test_analysis.py``
and ``tests/test_crosscheck.py`` that the port's ops can build.  The
listed exceptions:

* ``shape-dtype`` ERROR findings for op types the port does not register
  (its executor refuses them; the JAX package registers them);
* ``dtype-clash`` ERROR findings of the JAX package at the float32
  promotions of an AMP program: a gray op (on neither AMP list) that
  reads a bf16 and a float32 operand.  The port's verifier accepts them
  (``typecheck._amp_promotion``); the JAX package's findings left out
  must be exactly those sites, found here from the program itself.

Hooks: the executor's plan-cache miss (``assert_valid`` and
``assert_scope_valid`` under FLAGS_program_verify), the pass sandwiches
around ``append_backward``, ``apply_conv_bn_fusion`` and
``freeze_program``, the op-callstack attr naming this file, and the
fixers.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid import analysis as jan
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.inference.freeze import freeze_program as jfreeze
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.contrib.mixed_precision import fp16_lists as tfl
from paddle_tpu_torch.fluid import analysis as tan
from paddle_tpu_torch.fluid import backward as tbackward
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import fusion_pass as tfusion
from paddle_tpu_torch.fluid.analysis import ERROR, ProgramVerifyError
from paddle_tpu_torch.fluid.analysis.typecheck import _ALIGNED_OPS
from paddle_tpu_torch.fluid.checkpoint import (CheckpointManager,
                                               RestoreMismatchError)
from paddle_tpu_torch.fluid.dtypes import dtype_name, is_floating
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.inference import freeze_program as tfreeze
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
import test_torch_bert_infer as bi
import test_torch_bert_train as bt
import test_torch_hapi_nmt as hn
import test_torch_resnet as rn

THIS_FILE = os.path.abspath(__file__)
JAX = (jfluid, jan)
TORCH = (tfluid, tan)


@pytest.fixture
def verify_flag():
    tflags.set_flags({"FLAGS_program_verify": True})
    yield
    tflags.set_flags({"FLAGS_program_verify": False})


def _key(findings):
    return sorted((f.check, f.severity, f.block_idx,
                   -1 if f.op_index is None else f.op_index, f.var or "")
                  for f in findings)


def amp_promotion_sites(program) -> list:
    """(block, op index, first operand) of each gray op of an AMP
    program (an ``_ALIGNED_OPS`` type on neither AMP list) whose float
    operands are exactly bf16 and float32."""
    if not getattr(program, "_amp_enabled", False):
        return []
    out = []
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if op.type not in _ALIGNED_OPS or op.type in tfl.white_list \
                    or op.type in tfl.black_list:
                continue
            dts = [(n, block._find_var_recursive(n).dtype)
                   for n in op.input_names()
                   if block._find_var_recursive(n) is not None
                   and block._find_var_recursive(n).dtype is not None]
            floats = {dtype_name(d) for _, d in dts if is_floating(d)}
            if floats == {"bfloat16", "float32"}:
                out.append((block.idx, i, dts[0][0]))
    return sorted(out)


def _without_promotions(jfindings, tm) -> list:
    """The JAX package's findings less its dtype-clash ERRORs at the AMP
    promotion sites of ``tm``, after checking those are exactly the
    sites: one ERROR each, nothing else there."""
    sites = amp_promotion_sites(tm)
    at = [f for f in jfindings
          if (f.block_idx, f.op_index, f.var) in set(sites)]
    assert sorted((f.block_idx, f.op_index, f.var) for f in at) == sites
    assert {(f.check, f.severity) for f in at} <= {("dtype-clash", ERROR)}
    return [f for f in jfindings if all(f is not g for g in at)]


def _assert_parity(jm, tm, live_out=()):
    jf = jan.verify_program(jm, live_out=live_out)
    tf = tan.verify_program(tm, live_out=live_out)
    assert _key(tf) == _key(_without_promotions(jf, tm))
    return tf


def _assert_live_ranges(jm, tm, **kw):
    ja, ta = jan.analyze_live_ranges(jm, **kw), tan.analyze_live_ranges(
        tm, **kw)

    def rows(a):
        return [(b.name, b.bytes, b.shape, b.dtype, b.category, b.first_def,
                 b.last_use, b.op_index, b.op_type, b.donated,
                 b.persistable, b.batch_scaled) for b in a.buffers]

    assert rows(ta) == rows(ja)
    assert (ta.peak_bytes, ta.peak_op_index, ta.peak_op_type, ta.n_ops,
            ta.categories, ta.categories_at_peak, ta.resident_bytes,
            ta.model_bytes, ta.live_bytes_at, ta.unsized,
            sorted(ta.live_at_peak)) == (
        ja.peak_bytes, ja.peak_op_index, ja.peak_op_type, ja.n_ops,
        ja.categories, ja.categories_at_peak, ja.resident_bytes,
        ja.model_bytes, ja.live_bytes_at, ja.unsized,
        sorted(ja.live_at_peak))
    return ta


# ---------------------------------------------------------------------------
# the programs the card runs, at tiny widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse,amp", [(True, True), (True, False),
                                      (False, True)],
                         ids=["fused-bf16", "fused-f32", "layers-bf16"])
def test_bert_train_findings_match_jax(fuse, amp):
    _, jm, jst, jl = bt._build(jfluid, jnn, jbert, jmp, "tiny", fuse, amp)
    _, tm, tst, tl = bt._build(tfluid, tnn, tbert, tmp, "tiny", fuse, amp)
    tf = _assert_parity(jm, tm, live_out=[tl.name])
    assert not [f for f in tf if f.severity == ERROR]
    assert bool(amp_promotion_sites(tm)) == amp
    assert _key(tan.verify_pair(tm, startup=tst)) == _key(
        jan.verify_pair(jm, startup=jst))
    _assert_live_ranges(jm, tm, fetch_names=[tl.name])


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_resnet_after_fusion_findings_match_jax(amp):
    cfg = "bottleneck"
    jm, _, jl = rn._build(jfluid, jflags, jres, jmp, rn._cfg(jres, cfg), 2,
                          32, True, amp)
    tm, _, tl = rn._build(tfluid, tflags, tres, tmp, rn._cfg(tres, cfg), 2,
                          32, True, amp)
    assert any(op.type == "fused_conv_bn" for op in tm.global_block().ops)
    tf = _assert_parity(jm, tm, live_out=[tl.name])
    assert not [f for f in tf if f.severity == ERROR]
    _assert_live_ranges(jm, tm, fetch_names=[tl.name], batch_hint=2)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_hapi_nmt_findings_match_jax(amp):
    jm, _, jl, _ = hn._build(hn.JAX, "tiny", amp=amp)
    tm, _, tl, _ = hn._build(hn.TORCH, "tiny", amp=amp)
    tf = _assert_parity(jm, tm, live_out=[tl.name])
    assert not [f for f in tf if f.severity == ERROR]
    _assert_live_ranges(jm, tm, fetch_names=[tl.name])


def test_frozen_bert_findings_match_jax():
    b, s = bi.CONFIGS["tiny"][1:]
    jm, js, jseq, jpool = bi._build(jfluid, jnn, jbert,
                                    bi._cfg(jbert, "tiny"), b, s)
    tm, ts, tseq, tpool = bi._build(tfluid, tnn, tbert,
                                    bi._cfg(tbert, "tiny"), b, s)
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    weights = {n: np.asarray(v) for n, v in jscope.vars.items()
               if v is not None}
    tscope = tfluid.Scope.from_numpy(weights, device="cpu")
    jf = jfreeze(jm, scope=jscope, fetch_list=[jseq, jpool])
    tf = tfreeze(tm, scope=tscope, fetch_list=[tseq, tpool])
    live = set(tf.feed_names) | set(tf.fetch_names)
    found = _assert_parity(jf.program, tf.program, live_out=live)
    assert not [f for f in found if f.severity == ERROR]
    assert _key(tan.verify_scope(tf.program, tf.scope,
                                 feed_names=tf.feed_names)) == _key(
        jan.verify_scope(jf.program, jf.scope, feed_names=jf.feed_names))
    _assert_live_ranges(jf.program, tf.program, feed_names=tf.feed_names,
                        fetch_names=tf.fetch_names)


def test_bf16_buffers_are_two_bytes_in_both_packages():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4, 8], append_batch_size=False)
            h = fluid.layers.cast(x, "bfloat16")
            out = fluid.layers.relu(h)
        return main, out

    jm, jo = build(jfluid)
    tm, to = build(tfluid)
    ta = _assert_live_ranges(jm, tm, feed_names=["x"], fetch_names=[to.name])
    by = ta.by_name()
    assert by[to.name].dtype == "bfloat16" and by[to.name].bytes == 64
    assert by["x"].bytes == 128


# ---------------------------------------------------------------------------
# broken programs: one per check the port's ops can build
# ---------------------------------------------------------------------------


def _fresh(fluid):
    return fluid.Program(), fluid.Program()


def _small_train(fluid, batch=4, with_opt=True):
    L = fluid.layers
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [batch, 8], append_batch_size=False)
        y = L.data("y", [batch, 1], append_batch_size=False)
        loss = L.mean(L.square_error_cost(L.fc(x, 4, act="relu"), y))
        if with_opt:
            fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _dangling(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fluid.layers.data("x", [4, 8], append_batch_size=False)
    main.global_block().append_op(
        type="relu", inputs={"X": ["ghost"]}, outputs={"Out": ["o"]},
        infer=False)
    return main, ()


def _use_before_def(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        h = fluid.layers.relu(x)
        fluid.layers.scale(h, scale=2.0)
    blk = main.global_block()
    blk.ops[0], blk.ops[1] = blk.ops[1], blk.ops[0]
    return main, ()


def _stale_writer(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        y = fluid.layers.relu(x)
    del main.global_block().ops[0]
    return main, (y.name,)


def _shape_mismatch(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        y = fluid.layers.fc(x, 4)
    main.global_block().var(y.name).shape = (9, 9)
    return main, (y.name,)


def _dtype_mismatch(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        y = fluid.layers.fc(x, 4)
    main.global_block().var(y.name).dtype = np.dtype("int32")
    return main, (y.name,)


def _dtype_clash(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        xh = fluid.layers.cast(x, "bfloat16")
        z = fluid.layers.elementwise_add(xh, x)
    return main, (z.name,)


def _fill_truncation(fluid):
    main, startup = _fresh(fluid)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        c = fluid.layers.fill_constant([2], "int32", 2.5)
    return main, (c.name,)


def _grad_integrity(fluid):
    main, _, loss = _small_train(fluid)
    blk = main.global_block()
    idx = next(i for i, op in enumerate(blk.ops)
               if loss.name + "@GRAD" in op.output_names())
    del blk.ops[idx]
    return main, ()


def _grad_shape_mirror(fluid):
    main, _, loss = _small_train(fluid)
    blk = main.global_block()
    gop = next(op for op in blk.ops
               if op.type.endswith("_grad")
               and op.attrs.get("__fwd_in_slots__"))
    slot = next(s for s in gop.attrs["__fwd_in_slots__"]
                if gop.outputs.get(s + "@GRAD"))
    gname = next(n for n in gop.outputs[slot + "@GRAD"]
                 if not n.endswith("@UNUSED"))
    blk._find_var_recursive(gname).shape = (1, 2, 3, 4)
    return main, ()


def _dead_op(fluid):
    main, startup, loss = _small_train(fluid)
    blk = main.global_block()
    blk.append_op(type="scale", inputs={"X": [loss.name]},
                  outputs={"Out": ["debris_0"]}, attrs={"scale": 2.0})
    blk.vars["x"].op = blk.ops[0]
    return main, ("x", "y", loss.name)


def _clean_train(fluid):
    main, _, loss = _small_train(fluid)
    return main, ("x", "y", loss.name)


BROKEN = {
    "dangling-ref": (_dangling, "dangling-ref"),
    "use-before-def": (_use_before_def, "use-before-def"),
    "stale-last-writer": (_stale_writer, "stale-last-writer"),
    "shape-mismatch": (_shape_mismatch, "shape-dtype"),
    "dtype-mismatch": (_dtype_mismatch, "shape-dtype"),
    "dtype-clash": (_dtype_clash, "dtype-clash"),
    "fill-truncation": (_fill_truncation, "fill-truncation"),
    "grad-integrity": (_grad_integrity, "grad-integrity"),
    "grad-shape-mirror": (_grad_shape_mirror, "grad-shape-mirror"),
    "dead-op": (_dead_op, "dead-op"),
    "clean": (_clean_train, None),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_program_findings_match_jax(name):
    build, check = BROKEN[name]
    jm, live = build(jfluid)
    tm, _ = build(tfluid)
    jf = jan.verify_program(jm, live_out=live)
    tf = tan.verify_program(tm, live_out=live)
    assert _key(tf) == _key(jf)
    if check is None:
        assert tf == []
    else:
        assert check in {f.check for f in tf}
    assert sorted(f.message for f in tf) == sorted(f.message for f in jf)


def test_unregistered_op_type_is_an_error_only_in_the_port():
    """The listed exception: an op type the JAX package registers and
    the port does not."""
    def build(fluid):
        main, startup = _fresh(fluid)
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4, 8], append_batch_size=False)
        main.global_block().append_op(
            type="sigmoid", inputs={"X": [x.name]},
            outputs={"Out": ["s"]}, infer=False)
        main.global_block().var("s").shape = (4, 8)
        return main

    jf = jan.verify_program(build(jfluid), live_out={"s"})
    tf = tan.verify_program(build(tfluid), live_out={"s"})
    assert not [f for f in jf if f.severity == ERROR]
    (err,) = [f for f in tf if f.severity == ERROR]
    assert (err.check, err.op_type, err.op_index) == ("shape-dtype",
                                                      "sigmoid", 0)
    assert "no registered emitter" in err.message


# ---------------------------------------------------------------------------
# scope and cross-program checks
# ---------------------------------------------------------------------------


def test_scope_findings_match_jax():
    for fluid, an in (JAX, TORCH):
        main, startup, _ = _small_train(fluid)
        empty = an.verify_scope(main, fluid.Scope(), feed_names=["x", "y"])
        assert {f.check for f in empty} == {"scope-missing-persistable"}
    jm, js, _ = _small_train(jfluid)
    tm, ts, _ = _small_train(tfluid)
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(ts, scope=tscope)
    assert tan.verify_scope(tm, tscope, feed_names=["x", "y"]) == []
    cases = [("fc_0.w_0", np.zeros((3, 3), np.float32)),
             ("fc_0.w_0", np.zeros((8, 4), np.int32)),
             ("stale_from_other_program", np.zeros(2, np.float32))]
    for name, value in cases:
        jscope.set_var(name, value)
        tscope.set_var(name, value)
        assert _key(tan.verify_scope(tm, tscope, feed_names=["x", "y"])) \
            == _key(jan.verify_scope(jm, jscope, feed_names=["x", "y"]))
    tscope.vars["fc_0.b_0"] = None
    fs = tan.verify_scope(tm, tscope, feed_names=["x", "y"])
    assert "scope-uninitialized" in {f.check for f in fs}
    assert any(os.path.basename(THIS_FILE) in f.format() for f in fs
               if f.severity == ERROR)


def test_scope_lint_reads_tensors_and_bf16():
    import torch

    tm, ts, _ = _small_train(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(ts, scope=scope)
    scope.set_var("fc_0.w_0", torch.zeros(8, 4, dtype=torch.bfloat16))
    fs = tan.verify_scope(tm, scope, feed_names=["x", "y"])
    (f,) = fs
    assert f.check == "scope-dtype-mismatch" and "bfloat16" in f.message


def test_pair_findings_match_jax():
    def pair(fluid):
        L = fluid.layers
        main, startup = _fresh(fluid)
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = L.data("x", [4, 8], append_batch_size=False)
            y = L.data("y", [4, 1], append_batch_size=False)
            h = L.dropout(L.fc(x, 6, act="relu"), dropout_prob=0.3)
            loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
            eval_prog = main.clone(for_test=True)
            fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        return main, startup, eval_prog

    (jm, js, je), (tm, ts, te) = pair(jfluid), pair(tfluid)
    kw = dict(feed_names=["x", "y"])
    assert _key(tan.verify_pair(tm, startup=ts, eval_program=te, **kw)) \
        == _key(jan.verify_pair(jm, startup=js, eval_program=je, **kw)) \
        == []
    # a train-mode clone: clone-train-mode and clone-grad-op
    got = tan.verify_pair(tm, eval_program=tm.clone(for_test=False))
    assert _key(got) == _key(jan.verify_pair(
        jm, eval_program=jm.clone(for_test=False)))
    assert {"clone-train-mode", "clone-grad-op"} <= {f.check for f in got}
    # a missing startup initializer
    for m, s in ((jm, js), (tm, ts)):
        blk = s.global_block()
        blk._remove_op(next(i for i, op in enumerate(blk.ops)
                            if "fc_0.b_0" in op.output_names()))
    got = tan.verify_pair(tm, startup=ts, **kw)
    assert _key(got) == _key(jan.verify_pair(jm, startup=js, **kw))
    assert [f.var for f in got] == ["fc_0.b_0"]


def test_ps_program_raises_naming_the_parameter_server_slice():
    """The parameter server is ported, so a program with a
    distributed_lookup_table op is checked, not refused: a missing table
    and a table of another dim are the JAX package's ERROR findings."""
    from paddle_tpu.distributed import ps as jps
    from paddle_tpu_torch.distributed import ps as tps

    progs = {}
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        blk = prog.global_block()
        blk.create_var(name="ids", shape=(4, 1), dtype="int64")
        blk.create_var(name="emb", shape=(4, 8), dtype="float32")
        blk.append_op(type="distributed_lookup_table",
                      inputs={"Ids": ["ids"]}, outputs={"Outputs": ["emb"]},
                      attrs={"table_names": ["emb_table"]}, infer=False)
        progs[fluid] = prog
    for dim, want in ((None, ["ps-table-missing"]),
                      (7, ["ps-table-geometry"]), (8, [])):
        for mod in (jps, tps):
            mod.drop_table("emb_table")
            if dim is not None:
                mod.create_table("emb_table", shape=(10, dim))
        got = tan.verify_pair(progs[tfluid])
        assert [f.check for f in got] == want
        assert _key(got) == _key(jan.verify_pair(progs[jfluid]))
    for mod in (jps, tps):
        mod.drop_table("emb_table")
    assert tan.check_ps_geometry(tfluid.Program()) == []


# ---------------------------------------------------------------------------
# the hooks: executor, sandwiches, callstacks
# ---------------------------------------------------------------------------


def test_op_callstack_names_this_file_and_can_be_disabled():
    main, _, _ = _small_train(tfluid)
    op = main.global_block().ops[0]
    frame = tan.user_frame(op.attrs[tfluid.framework.OP_CALLSTACK_ATTR])
    assert os.path.abspath(frame[0]) == THIS_FILE
    assert frame[2] == "_small_train"
    tflags.set_flags({"FLAGS_op_callstack": False})
    try:
        main, _, _ = _small_train(tfluid)
        assert all(tfluid.framework.OP_CALLSTACK_ATTR not in op.attrs
                   for op in main.global_block().ops)
    finally:
        tflags.set_flags({"FLAGS_op_callstack": True})


def test_user_frame_skips_the_ports_frames():
    pkg = os.path.dirname(os.path.abspath(tfluid.__file__))
    stack = ((os.path.join(pkg, "layers", "nn.py"), 10, "fc"),
             ("/elsewhere/user.py", 3, "build"))
    assert tan.user_frame(stack) == ("/elsewhere/user.py", 3, "build")
    assert tan.user_frame(stack[:1]) is None


def test_executor_raises_before_any_op_runs(verify_flag, monkeypatch):
    main, startup, loss = _small_train(tfluid)
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    feed = {"x": np.zeros((4, 8), "f4"), "y": np.zeros((4, 1), "f4")}
    from paddle_tpu_torch.ops import registry

    ran = []
    real = registry.emit_ops
    monkeypatch.setattr(registry, "emit_ops",
                        lambda *a, **k: (ran.append(1), real(*a, **k))[1])
    with pytest.raises(ProgramVerifyError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert "scope-missing-persistable" in str(ei.value)
    assert "fc_0.w_0" in str(ei.value) and ran == []
    exe.run(startup, scope=scope)
    (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    # a dangling read: the error names this file's layer call
    broken, _ = _dangling(tfluid)
    with pytest.raises(ProgramVerifyError) as ei:
        exe.run(broken, feed={"x": np.zeros((4, 8), "f4")},
                fetch_list=["o"], scope=scope)
    assert any(f.check == "dangling-ref" for f in ei.value.findings)


def test_executor_hook_names_the_user_line(verify_flag):
    """The seeded fault of the card's ``verify`` phase: an op reading a
    var nothing writes raises before any op runs, at the line that
    appended it."""
    import inspect

    main, startup = _fresh(tfluid)
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4, 8], append_batch_size=False)
        tfluid.layers.relu(x)
    line = inspect.currentframe().f_lineno + 1
    main.global_block().append_op(type="relu", inputs={"X": ["ghost"]},
                                  outputs={"Out": ["o"]}, infer=False)
    with pytest.raises(ProgramVerifyError) as ei:
        tfluid.Executor(device="cpu").run(
            main, feed={"x": np.zeros((4, 8), "f4")}, fetch_list=["o"],
            scope=tfluid.Scope())
    assert [f.check for f in ei.value.findings
            if f.severity == ERROR] == ["dangling-ref"]
    assert f"{THIS_FILE}:{line} in test_executor_hook_names_the_user_line" \
        in str(ei.value)


def test_flag_off_runs_no_check(monkeypatch):
    main, startup, loss = _small_train(tfluid)
    calls = []
    from paddle_tpu_torch.fluid import analysis

    monkeypatch.setattr(analysis, "assert_valid",
                        lambda *a, **k: calls.append(1))
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.zeros((4, 8), "f4"),
                        "y": np.zeros((4, 1), "f4")},
            fetch_list=[loss], scope=scope)
    assert calls == []


def test_verify_is_read_only():
    main, _, loss = _small_train(tfluid)
    v0 = main._version
    tan.verify_program(main, live_out={loss.name})
    tan.analyze_live_ranges(main)
    assert main._version == v0


def test_pass_sandwich_attributes_new_findings(verify_flag):
    main, _, loss = _small_train(tfluid)
    with pytest.raises(ProgramVerifyError) as ei:
        with tan.pass_sandwich(main, "evil_pass", live_out={loss.name}):
            del main.global_block().ops[0]
    assert all(f.pass_name == "evil_pass" for f in ei.value.findings)
    # a broken input is blamed on its producer, not on the next pass
    with pytest.raises(ProgramVerifyError, match="input of pass"):
        with tan.pass_sandwich(main, "next_pass"):
            pass
    tflags.set_flags({"FLAGS_program_verify": False})
    with tan.pass_sandwich(main, "evil_pass"):  # flag off: no check
        del main.global_block().ops[0]


def test_backward_fusion_and_freeze_are_sandwiched(verify_flag,
                                                   monkeypatch):
    seen = []
    real = tan.sandwich.verify_program
    monkeypatch.setattr(tan.sandwich, "verify_program",
                        lambda p, **k: (seen.append(id(p)), real(p, **k))[1])
    L = tfluid.layers
    main, startup = _fresh(tfluid)
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = L.data("img", [2, 3, 8, 8], append_batch_size=False)
        h = L.relu(L.batch_norm(L.conv2d(img, 4, 3, padding=1,
                                         bias_attr=False)))
        loss = L.mean(h)
    assert tfusion.apply_conv_bn_fusion(main) == 1
    tbackward.append_backward(loss)
    assert len(seen) == 4  # before and after each pass
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    fm = tfreeze(main, scope=scope, fetch_list=[loss])
    assert len(seen) == 8  # the prune's sandwich, then the fold's
    assert [op.type for op in fm.program.global_block().ops].count(
        "fused_conv_bn") == 1  # fused in training, folded at run time
    # a pass that breaks the program raises, attributed to it
    monkeypatch.setattr(tfusion, "_try_fuse_at",
                        lambda block, i: bool(block.ops.pop(i)) and False)
    main2, _ = _fresh(tfluid)
    with tfluid.program_guard(main2, tfluid.Program()):
        x = L.data("x", [4, 8], append_batch_size=False)
        L.scale(L.relu(x), scale=2.0)
    with pytest.raises(ProgramVerifyError, match="conv_bn_fusion"):
        tfusion.apply_conv_bn_fusion(main2)


def test_freeze_verifies_its_result_unconditionally(monkeypatch):
    main, startup, loss = _small_train(tfluid, with_opt=False)
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    from paddle_tpu_torch.inference import freeze as fz

    monkeypatch.setattr(fz, "verify_program",
                        lambda p, live_out=(): [tan.Finding(
                            "dangling-ref", ERROR, "planted")])
    with pytest.raises(ProgramVerifyError, match="freeze_program result"):
        tfreeze(main, scope=scope, fetch_list=[loss])


def test_fixers_repair_and_train_bit_identically():
    clean, startup, loss = _small_train(tfluid)
    live = {"x", "y", loss.name}
    feed = {"x": np.random.RandomState(0).rand(4, 8).astype("f4"),
            "y": np.random.RandomState(1).rand(4, 1).astype("f4")}

    def losses(prog):
        scope = tfluid.Scope()
        exe = tfluid.Executor(device="cpu")
        exe.run(startup, scope=scope)
        return [exe.run(prog, feed=feed, fetch_list=[loss],
                        scope=scope)[0].item() for _ in range(3)]

    ref = losses(clean)
    broken = clean.clone()
    blk = broken.global_block()
    blk.append_op(type="scale", inputs={"X": [loss.name]},
                  outputs={"Out": ["debris_0"]}, attrs={"scale": 2.0})
    blk.vars["x"].op = blk.ops[0]
    fs = tan.verify_program(broken, live_out=live)
    assert {"stale-last-writer"} <= {f.check for f in fs
                                     if f.severity == ERROR}
    reports = tan.apply_fixes(broken, live_out=live)
    assert {r.name for r in reports if r.changed} == {"dead-code",
                                                      "stale-last-writer"}
    assert tan.verify_program(broken, live_out=live) == []
    assert losses(broken) == ref


def test_restore_mismatch_names_the_var_and_applies_nothing(tmp_path):
    main, startup, _ = _small_train(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    good = scope.find_var("fc_0.w_0").clone()
    mgr = CheckpointManager(str(tmp_path), scope=scope, device="cpu")
    scope.set_var("fc_0.w_0", np.zeros((8, 9), np.float32))
    mgr.save(1)
    mgr.save(2)
    scope.set_var("fc_0.w_0", good)
    with pytest.raises(RestoreMismatchError) as ei:
        mgr.restore(program=main)
    msg = str(ei.value)
    assert "fc_0.w_0" in msg and "(8, 4)" in msg and "(8, 9)" in msg
    assert scope.find_var("fc_0.w_0") is good
    assert all(f.severity == ERROR for f in ei.value.findings)
