"""The port stands alone: no module of paddle_tpu_torch, and not
chip_smoke.py, imports jax or anything of paddle_tpu; entry points run
on the card unless the caller asks for the CPU (the serving replica,
the file-based predictor and the server's command line included); the
CUDA wrapper's input checks refuse what the kernel does not take;
``init_parallel_env`` picks NCCL for a CUDA device and gloo only for the
CPU or when named, and never falls back; the launcher and the ranks it
starts import neither jax nor paddle_tpu, and a pserver it starts sees
no card."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference.kv_cache import PagedKVPool
from paddle_tpu_torch import fluid
from paddle_tpu_torch.inference import shared_executor
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import paged_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import pkgutil, sys, importlib
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
sys.path.insert(0, "tests")
import torch_dist_ranks  # the multi-rank tests' rank bodies
from paddle_tpu_torch.parallel import create_mesh
import numpy as np
z = np.arange(12, dtype=np.float32).reshape(4, 3)
torch_dist_ranks._collective_cases(create_mesh({"dp": 1}), {
    "x": z[:2], "xr": z[:2], "xs": z[0], "ct": z[:2], "ct_rs": z[:2],
    "w": z[:2], "ct_id": z[:2]})
# the tensor- and pipeline-parallel paths on meshes without a process
# group (every collective the identity): the regions, GPipe, fleet
from paddle_tpu_torch.parallel import Mesh
rng = np.random.default_rng(0)
f = lambda *s: rng.standard_normal(s).astype(np.float32)
torch_dist_ranks._tp_op_cases(Mesh({"dp": 2, "tp": 2}), {
    "table": f(12, 6), "ids": np.array([[3, 0, 11, -2]], np.int32),
    "padding_idx": 5, "ct_lookup": f(1, 4, 6), "trans": f(5, 6),
    "ct_head": f(5, 6), "c": f(3, 4), "c_rank": f(2, 3, 4)})
import torch
from paddle_tpu_torch.ops import encoder_stack, registry
stack = {k: torch.as_tensor(f(1, *s)).requires_grad_() for k, s in (
    ("QKVW", (16, 48)), ("QKVB", (48,)), ("OutW", (16, 16)), ("OutB", (16,)),
    ("Ln1S", (16,)), ("Ln1B", (16,)), ("FfnW1", (16, 32)), ("FfnB1", (32,)),
    ("FfnW2", (32, 16)), ("FfnB2", (16,)), ("Ln2S", (16,)),
    ("Ln2B", (16,)))}
hid = torch.as_tensor(f(4, 8, 16)).requires_grad_()
out = registry.get("fused_encoder_stack").emit(
    registry.EmitContext(device="cpu", mesh=Mesh({"pp": 2})),
    {"Hidden": [hid], **{k: [v] for k, v in stack.items()}},
    {"num_heads": 4, "is_test": True, "use_flash_attention": False,
     "pipeline": True, "num_microbatches": 2})["Out"][0]
out.sum().backward()
assert stack["QKVW"].grad is not None
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "paddle_tpu"
             or m.startswith("paddle_tpu."))
print(len(names), bad)
assert not bad, bad
for n in ("fluid", "fluid.layers", "fluid.executor", "fluid.framework",
          "inference.freeze", "inference.predictor", "models.bert",
          "ops.attention", "ops.nn_ops", "ops.kernels.flash_attention",
          "ops.kernels.add_ln", "ops.kernels._build", "fluid.backward",
          "fluid.optimizer", "fluid.clip", "fluid.regularizer",
          "ops.encoder_stack", "ops.optimizer_ops",
          "contrib.mixed_precision", "contrib.mixed_precision.decorator",
          "contrib.mixed_precision.fp16_utils",
          "contrib.mixed_precision.fp16_lists", "ops.kernels.conv_bn",
          "fluid.fusion_pass", "models.resnet", "fluid.layers.nn",
          "fluid.layers.misc", "fluid.layers.tensor", "hapi", "hapi.text",
          "fluid.io", "fluid.crypto", "inference.server", "inference.client",
          "inference.weight_sync", "distributed.ps_server",
          "distributed.faults", "fluid.analysis", "fluid.analysis.core",
          "fluid.analysis.structure", "fluid.analysis.dataflow",
          "fluid.analysis.typecheck", "fluid.analysis.gradcheck",
          "fluid.analysis.scopecheck", "fluid.analysis.liverange",
          "fluid.analysis.crosscheck", "fluid.analysis.fixes",
          "fluid.analysis.sandwich", "fluid.checkpoint", "fluid.monitor",
          "fluid.dygraph", "fluid.dygraph.checkpoint", "hapi.callbacks",
          "hapi.metrics", "parallel", "parallel.env",
          "parallel.ring_attention", "distributed", "ops.collective_ops",
          "fleet", "fleet.base.distributed_strategy",
          "fleet.base.role_maker", "fleet.metrics", "distributed.ps",
          "distributed.launch", "distributed.heartbeat",
          "distributed.coordinator", "ops.ps_ops", "fluid.layers.sequence",
          "fluid.transpiler", "telemetry.export"):
    assert "paddle_tpu_torch." + n in names, n
"""


def test_port_imports_no_jax_and_no_paddle_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 40  # every module of the port was imported


def test_resolve_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dm.TinyDecoderLM(dm.DecoderConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVPool(n_pages=2, page_size=2, n_layers=1, kv_heads=1,
                    head_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.Scope.from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shared_executor()
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert fluid.Executor(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert paddle_tpu_torch.resolve_device(None) == torch.device("cuda")


def test_every_kernel_source_builds_into_its_own_library(monkeypatch,
                                                         tmp_path):
    srcs = _build.sources()
    assert sorted(srcs) == ["add_ln", "conv_bn", "flash_attention_bhsd",
                            "flash_attention_bsh", "paged_attention"]
    libs = {_build.lib_path(n) for n in srcs}
    assert len(libs) == 5 and all(os.path.basename(p).startswith("lib")
                                  for p in libs)
    # a compiler that refuses every source: one error naming each source,
    # with its log, after all of them ran
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: sys.executable)
    with pytest.raises(_build.KernelBuildError) as err:
        _build.build_all()
    for path in srcs.values():
        assert path in str(err.value)
    assert "Unknown option" in str(err.value)  # the compiler's own output
    with pytest.raises(_build.KernelBuildError, match="no kernel source"):
        _build.build("no_such_kernel")


def _good(b=2, h=4, kh=4, d=64, page=4, n_pages=6, maxp=3):
    return dict(q=torch.zeros(b, h, d), k=torch.zeros(n_pages, page, kh, d),
                v=torch.zeros(n_pages, page, kh, d),
                table=torch.zeros(b, maxp, dtype=torch.int32),
                lens=torch.ones(b, dtype=torch.int32))


def _check(x):
    pa.check_kernel_inputs(x["q"], x["k"], x["v"], x["table"], x["lens"])


@pytest.mark.parametrize("kw", [dict(), dict(d=128), dict(d=256),
                                dict(h=8, kh=2)],
                         ids=["d64", "d128", "d256", "gqa"])
def test_kernel_check_accepts_supported_inputs(kw):
    _check(_good(**kw))
    x = _good(**kw)
    x.update(q=x["q"].bfloat16(), k=x["k"].bfloat16(), v=x["v"].bfloat16())
    _check(x)


BAD = {
    "q_float64": lambda x: x.update(q=x["q"].double()),
    "q_float16": lambda x: x.update(q=x["q"].half()),
    "k_dtype_differs": lambda x: x.update(k=x["k"].bfloat16()),
    "table_int64": lambda x: x.update(table=x["table"].long()),
    "lengths_int64": lambda x: x.update(lens=x["lens"].long()),
    "q_2d": lambda x: x.update(q=x["q"][0]),
    "head_dim_32": lambda x: x.update(q=x["q"][..., :32],
                                      k=x["k"][..., :32].contiguous(),
                                      v=x["v"][..., :32].contiguous()),
    "k_v_shapes_differ": lambda x: x.update(v=x["v"][:-1]),
    "heads_not_grouped": lambda x: x.update(k=torch.zeros(6, 4, 3, 64),
                                            v=torch.zeros(6, 4, 3, 64)),
    "table_rows": lambda x: x.update(table=x["table"][:1]),
    "lengths_shape": lambda x: x.update(lens=x["lens"][:1]),
    "q_not_contiguous": lambda x: x.update(
        q=torch.zeros(2, 64, 4).transpose(1, 2)),
    "k_not_contiguous": lambda x: x.update(
        k=torch.zeros(6, 4, 64, 4).transpose(2, 3)),
    "table_not_contiguous": lambda x: x.update(
        table=torch.zeros(3, 2, dtype=torch.int32).t()),
    "q_misaligned": lambda x: x.update(q=torch.zeros(2 * 4 * 64 + 1)[1:]
                                       .view(2, 4, 64)),
    "k_other_device": lambda x: x.update(
        k=torch.zeros(6, 4, 4, 64, device="meta")),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_kernel_check_refuses(name):
    x = _good()
    BAD[name](x)
    with pytest.raises(ValueError):
        _check(x)


_RESNET_PROBE = r"""
import sys
import numpy as np
from paddle_tpu_torch import fluid
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.models import resnet
cfg = resnet.ResNetConfig(50, 10, [1, 1], base_filters=8)
main, startup = fluid.Program(), fluid.Program()
flags.set_flags({"FLAGS_conv_bn_fusion": True})
m, st, _, loss = resnet.build_resnet_train_program(cfg, 2, 32, main, startup)
with fluid.program_guard(m, st):
    opt = mixed_precision.decorate(
        fluid.optimizer.MomentumOptimizer(0.1, momentum=0.9), use_bf16=True)
    opt.minimize(loss)
types = [op.type for op in m.global_block().ops]
assert types.count("fused_conv_bn") == 9, types
exe = fluid.Executor(device="cpu")
scope = fluid.Scope()
exe.run(st, scope=scope)
rng = np.random.default_rng(0)
feed = {"image": rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
        "label": rng.integers(0, 10, (2, 1))}
(lv,) = exe.run(m, feed=feed, fetch_list=[loss], scope=scope)
assert np.isfinite(lv).all(), lv
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("ok", float(lv[0]))
"""


def test_resnet_trains_with_fusion_and_amp_without_jax():
    """The ResNet training path (fusion, Momentum, bf16 AMP, Executor)
    runs a step in a process that never imports jax or paddle_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RESNET_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_a_shared_header_change_rebuilds_every_library(monkeypatch,
                                                       tmp_path):
    """A library is named by its source and the shared ``csrc/*.cuh``
    headers, so a header edit builds anew instead of loading a stale
    library."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {n: _build.lib_path(n) for n in _build.sources()}
    with open(csrc / "flash_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.lib_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)


_NMT_PROBE = r"""
import sys
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.hapi import text
b, s, v, h, nh = 2, 128, 32, 128, 2
main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    ids = layers.data("ids", [b, s], "int64", append_batch_size=False)
    bias = layers.data("bias", [b, nh, s, s], append_batch_size=False)
    lbl = layers.data("lbl", [b, s, 1], "int64", append_batch_size=False)
    x = layers.add_position_encoding(layers.embedding(ids, size=[v, h]),
                                     1.0, 1.0)
    enc = text.TransformerEncoder(1, nh, d_model=h, d_inner_hid=2 * h)
    dec = text.TransformerDecoder(1, nh, d_model=h, d_inner_hid=2 * h)
    logits = layers.fc(dec(x, enc(x, bias), None), v, num_flatten_dims=2)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, lbl))
    fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
scope, exe = fluid.Scope(), fluid.Executor(device="cpu")
exe.run(startup, scope=scope)
rng = np.random.default_rng(0)
feed = {"ids": rng.integers(0, v, (b, s)), "lbl": rng.integers(0, v, (b, s, 1)),
        "bias": np.zeros((b, nh, s, s), np.float32)}
(lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
assert np.isfinite(lv).all(), lv
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("ok", float(lv[0]))
"""


def test_hapi_nmt_trains_without_jax():
    """The hapi encoder-decoder with a full encoder bias (the BHSD
    branch) runs a training step in a process that never imports jax or
    paddle_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NMT_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


_CKPT_PROBE = r"""
import sys, tempfile
import numpy as np
import torch
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.hapi import Callback, Input, Model

def net(x):
    h = fluid.layers.fc(x, 8, act="relu")
    return fluid.layers.fc(fluid.layers.dropout(h, dropout_prob=0.2), 1)

def model():
    m = Model(net, Input("x", [4, 3]), Input("y", [4, 1]), device="cpu")
    m.prepare(fluid.optimizer.AdamOptimizer(1e-2), lambda p, y:
              fluid.layers.mean(fluid.layers.square_error_cost(p, y)))
    return m

class Stop(Callback):
    def on_batch_end(self, mode, step, logs=None):
        if step == 2:
            ckpt.request_preemption()

rng = np.random.RandomState(0)
data = (rng.randn(16, 3).astype(np.float32), rng.randn(16, 1).astype(np.float32))
ref = model().fit(data, batch_size=4, epochs=2, verbose=0)
d = tempfile.mkdtemp()
try:
    model().fit(data, batch_size=4, epochs=2, verbose=0, checkpoint_dir=d,
                callbacks=[Stop()])
except ckpt.Preempted:
    ckpt.clear_preemption()
got = model().fit(data, batch_size=4, epochs=2, verbose=0, checkpoint_dir=d,
                  resume=True)
assert got == ref, (got, ref)
scope = fluid.Scope()
scope.set_var("h", torch.ones(3, dtype=torch.bfloat16))
mgr = ckpt.CheckpointManager(d + "/b", scope=scope, device="cpu")
mgr.save(1)
back = fluid.Scope()
ckpt.CheckpointManager(d + "/b", scope=back, device="cpu").restore()
assert back.find_var("h").dtype == torch.bfloat16
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu", "ml_dtypes"))
assert not bad, bad
print("ok")
"""


def test_fit_checkpoints_and_resumes_without_jax_or_ml_dtypes():
    """Model.fit preempted and resumed, and a bf16 checkpoint written and
    read, in a process that never imports jax, paddle_tpu or ml_dtypes
    (the card's installation has no ml_dtypes)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CKPT_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


_SERVE_PROBE = r"""
import os, sys, tempfile
import numpy as np
os.environ["PADDLE_SERVE_WEIGHT_SYNC"] = "0"
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import server
from paddle_tpu_torch.inference.client import InferenceClient
d = tempfile.mkdtemp()
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", [8], dtype="float32")
    pred = fluid.layers.fc(x, 4)
exe = fluid.Executor(device="cpu")
with fluid.scope_guard(fluid.Scope()):
    exe.run(startup)
    fluid.io.save_inference_model(d, ["x"], [pred], exe, main_program=main)
cfg = inference.Config(d)
cfg.disable_gpu()
out = inference.create_predictor(cfg).run([np.ones((2, 8), np.float32)])
assert out[0].shape == (2, 4)
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("ok", d)
"""


def test_saved_model_serves_without_jax(tmp_path):
    """Saving, loading and the file-based predictor run in a process that
    never imports jax or paddle_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_serving_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The replica, the file-based predictor and ``main`` without
    ``--device`` want the card, and raise where there is none instead of
    running on the CPU."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference import server

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        pred = fluid.layers.fc(x, 4)
    exe = fluid.Executor(device="cpu")
    d = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
    frozen = inference.load_frozen(d, device="cpu")
    monkeypatch.setenv("PADDLE_SERVE_WEIGHT_SYNC", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.InferenceServer(frozen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(inference.Config(d))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.load_frozen(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--model_dir", d, "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.io.load_inference_model(d, None)
    assert server._ACTIVE is None
    cfg = inference.Config(d)
    cfg.disable_gpu()
    assert inference.create_predictor(cfg).device == torch.device("cpu")
    srv = server.InferenceServer(frozen, device="cpu")
    assert srv.predictor.device == torch.device("cpu")
    srv.close()


def test_cli_replica_serves_and_drains_on_sigterm(tmp_path):
    """``python -m paddle_tpu_torch.inference.server --device cpu``: it
    prints its ``listening on`` line, answers ``infer`` and ``health``,
    and on SIGTERM stops admission, drains and exits 0."""
    import queue
    import signal
    import threading

    from paddle_tpu_torch.inference.client import InferenceClient

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        pred = fluid.layers.fc(x, 4)
    exe = fluid.Executor(device="cpu")
    d = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PADDLE_SERVE_WEIGHT_SYNC"] = "0"
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.server",
         "--model_dir", d, "--port", "0", "--host", "127.0.0.1",
         "--device", "cpu", "--max_batch", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(s) for s in proc.stdout],
                     daemon=True).start()
    try:
        line = lines.get(timeout=120)
        assert "listening on" in line, line
        ep = line.rsplit(" ", 1)[1].strip()
        cli = InferenceClient([ep], deadline_secs=30)
        res = cli.infer({"x": np.ones((2, 8), np.float32)})
        assert res.outputs[0].shape == (2, 4)
        assert cli.health()["ok"]
        cli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "SIGTERM: draining" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_init_parallel_env_picks_nccl_for_cuda_and_never_falls_back(
        monkeypatch):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import env

    assert env.choose_backend("cuda:0") == "nccl"
    assert env.choose_backend(torch.device("cuda", 1)) == "nccl"
    assert env.choose_backend("cpu") == "gloo"
    # no CUDA and no device named: raise, never a silent CPU/gloo group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(env, "_state", dict(env._state))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_parallel_env()
    # a CUDA device gets NCCL (the group itself is only made on the card)
    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    env.init_parallel_env(device="cuda:0", init_method="file:///x")
    assert seen[-1]["backend"] == "nccl"
    monkeypatch.setattr(env, "_state", dict(env._state, initialized=False))
    env.init_parallel_env(device="cuda:0", backend="gloo",
                          init_method="file:///x")
    assert seen[-1]["backend"] == "gloo"   # named by the caller
    # the heartbeat hook is ported (PADDLE_HEARTBEAT_DIR starts stamping);
    # the A8 hooks still raise
    for var in ("PADDLE_TRACE_DIR", "PADDLE_DEBUGZ_PORT"):
        monkeypatch.setenv(var, "1")
        with pytest.raises(NotImplementedError, match="not ported"):
            env.init_parallel_env(device="cpu")
        monkeypatch.delenv(var)


def test_init_parallel_env_on_the_cpu_is_gloo(tmp_path):
    """A real rank on the CPU: gloo, and a world-1 mesh with process
    groups whose collectives run through it."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "from paddle_tpu_torch.parallel import env, create_mesh\n"
        "from paddle_tpu_torch import distributed as d\n"
        f"dev = env.init_parallel_env(device='cpu', "
        f"init_method='file://{tmp_path}/store', timeout_s=30)\n"
        "assert dev.type == 'cpu' and dist.get_backend() == 'gloo'\n"
        "m = create_mesh({'dp': 1})\n"
        "assert m.group('dp') is not None\n"
        "x = torch.arange(4.0)\n"
        "assert torch.equal(d.all_reduce(x, 'sum', 'dp', mesh=m), x)\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]


_LAUNCHED_CHILD = r"""
import os, sys
import paddle_tpu_torch.distributed.coordinator
import paddle_tpu_torch.distributed.heartbeat
import paddle_tpu_torch.distributed.launch
from paddle_tpu_torch.fluid import checkpoint
from paddle_tpu_torch.parallel import env
import torch.distributed as dist
env.init_parallel_env(device="cpu", timeout_s=30)
assert env._state["liveness"] is not None      # stamps and renewals
dist.barrier()
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
open(os.path.join(sys.argv[1], "ok.%s" % env.get_rank()), "w").close()
dist.destroy_process_group()
"""

_LAUNCHER = r"""
import sys
from paddle_tpu_torch.distributed import launch
rc = launch.launch(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "paddle_tpu"))
print("LAUNCHER", rc, bad)
sys.exit(rc if not bad else 99)
"""


def test_the_launcher_and_its_children_import_no_jax(tmp_path):
    """The port's launcher (lease plane armed) and a rank it starts
    (process group over the launcher's rendezvous, heartbeat and lease
    renewals) import neither jax nor paddle_tpu; nor does a ``--serve``
    job: its launcher, and its replicas (heartbeats, leases, the decoder
    engine) map no jaxlib while they serve, and drain to exit 0."""
    child = tmp_path / "child.py"
    child.write_text(_LAUNCHED_CHILD)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", _LAUNCHER, "--nproc_per_node", "2",
         "--lease_secs", "5", "--log_dir", str(tmp_path / "logs"),
         str(child), str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120, cwd=REPO)
    logs = "".join((tmp_path / "logs" / f).read_text()
                   for f in sorted(os.listdir(tmp_path / "logs")))
    assert r.returncode == 0, r.stdout + r.stderr + logs
    assert "LAUNCHER 0 []" in r.stdout
    assert (tmp_path / "ok.0").exists() and (tmp_path / "ok.1").exists()

    import signal
    import socket
    import time

    from paddle_tpu_torch.distributed.ps_server import _Conn

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        pred = fluid.layers.fc(x, 4)
    exe = fluid.Executor(device="cpu")
    model = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(model, ["x"], [pred], exe,
                                      main_program=main)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    base = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-c", _LAUNCHER, "--serve", "--nproc_per_node",
         "2", "--started_port", str(base), "--lease_secs", "5",
         "--heartbeat_timeout", "5", "--log_dir",
         str(tmp_path / "serve_logs"), model, "--device", "cpu"],
        env=dict(env, PADDLE_SERVE_GEN="1", PADDLE_SERVE_WEIGHT_SYNC="0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    kids = []
    try:
        pending, deadline = {base, base + 1}, time.time() + 120
        while pending and time.time() < deadline:
            for port in list(pending):
                try:
                    if _Conn(f"127.0.0.1:{port}", deadline=1.0).call(
                            "health")["ok"]:
                        pending.discard(port)
                except Exception:  # noqa: BLE001
                    pass
            time.sleep(0.2)
        assert not pending, proc.stdout.read() if proc.poll() else pending
        for task in os.listdir(f"/proc/{proc.pid}/task"):
            with open(f"/proc/{proc.pid}/task/{task}/children") as f:
                kids += [int(k) for k in f.read().split()]
        assert len(kids) == 2, kids
        for pid in kids:
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            for lib in ("jaxlib", "xla_extension"):
                assert lib not in maps, (pid, lib)
            os.kill(pid, signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, out
        assert "LAUNCHER 0 []" in out
    finally:
        if proc.poll() is None:   # the launcher and its replicas
            for pid in kids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            proc.kill()
            proc.wait()


def test_a_launched_pserver_sees_no_card_and_imports_no_jax():
    """A pserver the launcher starts (``python -m paddle_tpu_torch.
    distributed.ps_server``) holds its tables in host memory: it runs
    with CUDA_VISIBLE_DEVICES empty, maps no CUDA driver and no jax
    library, and answers on the port it reported."""
    from paddle_tpu_torch.distributed import launch as tlaunch
    from paddle_tpu_torch.distributed import ps_server

    pservers, eps = tlaunch.start_pservers(1, "", "127.0.0.1")
    try:
        (p,) = pservers
        assert eps == [f"127.0.0.1:{p.port}"]
        assert ps_server._Conn(eps[0], deadline=10.0).call("ping") == "pong"
        with open(f"/proc/{p.proc.pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                       if b"=" in kv)
        assert env[b"CUDA_VISIBLE_DEVICES"] == b""
        assert env[b"PADDLE_TRAINING_ROLE"] == b"PSERVER"
        with open(f"/proc/{p.proc.pid}/maps") as f:
            maps = f.read()
        for lib in ("libcuda.so", "jaxlib", "xla_extension"):
            assert lib not in maps, lib
    finally:
        tlaunch.terminate_pservers(pservers)
